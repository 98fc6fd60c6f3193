"""The port's matrix module and precision layer against the JAX package.

The same NumPy inputs, made from a seed, go through
``veles.simd_tpu.ops.matrix`` / ``runtime.precision`` (on the CPU
platform the root conftest pins) and their ports with
``device="cpu"``.  Tolerances:

* fp32 GEMM / gemv: 1e-5 of max|y| between the packages (different
  summation orders), and the reference's ASSERT_NEAR 0.1 against the
  NumPy oracle (``tests/matrix.cc:94-98``);
* ``bf16_comp``, ``bf16``, ``default``: each within its
  ``ERROR_BUDGETS`` entry of float64, and port vs JAX within that
  budget;
* ``int8``: the int32 accumulators are bit-equal (both quantize with
  round-half-to-even); the rescaled results agree to an ulp.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from veles.simd_tpu.ops import matrix as jmx
from veles.simd_tpu.runtime import precision as jprx
from veles.simd_tpu_torch import obs as tobs
from veles.simd_tpu_torch.ops import matrix as tmx
from veles.simd_tpu_torch.runtime import precision as tprx
from veles.simd_tpu_torch.runtime import routing as trouting
from veles.simd_tpu_torch.utils import benchmark as tbench
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

FP32_TOL = 1e-5
# (w1, h1, w2) with h2 = w1, from tests/test_matrix.py's sweep
SWEEP = [(1, 1, 1), (3, 3, 3), (99, 99, 99), (125, 299, 64),
         (128, 300, 1000), (512, 512, 512)]
ROUTES = ["fp32", "bf16_comp", "int8", "bf16"]


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def telemetry():
    tobs.enable()
    tobs.reset()
    yield
    tobs.disable()
    tobs.reset()


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("mod,jmod", [(tmx, jmx), (tprx, jprx)])
def test_exports_the_jax_names(mod, jmod):
    assert set(jmod.__all__) <= set(mod.__all__)
    for name in jmod.__all__:
        assert hasattr(mod, name), name


def test_precision_constants_match():
    for name in ("JAX_PRECISIONS", "COMP_PRECISIONS", "PRECISIONS",
                 "ERROR_BUDGETS", "BF16_COMP_ENV", "INT8_ENV"):
        assert getattr(tprx, name) == getattr(jprx, name), name
    assert tprx.HIGHEST == "highest"
    assert tmx.GEMM_PRECISIONS == jmx.GEMM_PRECISIONS


@pytest.mark.parametrize("w,h", [(1, 1), (3, 7), (128, 64), (299, 125)])
@pytest.mark.parametrize("op", ["matrix_add", "matrix_sub"])
def test_add_sub(op, w, h):
    r = np.random.RandomState(w * 1000 + h)
    m1 = r.randn(h, w).astype(np.float32)
    m2 = r.randn(h, w).astype(np.float32)
    got = getattr(tmx, op)(m1, m2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(getattr(jmx, op)(m1, m2)))
    np.testing.assert_array_equal(getattr(tmx, op)(m1, m2, simd=False),
                                  getattr(jmx, op)(m1, m2, simd=False))


@pytest.mark.parametrize("w1,h1,w2", SWEEP)
@pytest.mark.parametrize("transposed", [False, True])
def test_multiply_matches_jax(w1, h1, w2, transposed):
    r = np.random.RandomState(w1 + h1 + w2)
    m1 = r.randn(h1, w1).astype(np.float32)
    if transposed:
        m2 = r.randn(w2, w1).astype(np.float32)
        fn, jfn = tmx.matrix_multiply_transposed, \
            jmx.matrix_multiply_transposed
    else:
        m2 = r.randn(w1, w2).astype(np.float32)
        fn, jfn = tmx.matrix_multiply, jmx.matrix_multiply
    got = fn(m1, m2)
    assert got.dtype == torch.float32 and tuple(got.shape) == (h1, w2)
    want = np.asarray(jfn(m1, m2))
    assert _rel(got.numpy(), want) <= FP32_TOL
    np.testing.assert_allclose(got.numpy(), fn(m1, m2, simd=False),
                               atol=0.1)     # tests/matrix.cc:98
    np.testing.assert_array_equal(fn(m1, m2, simd=False),
                                  jfn(m1, m2, simd=False))


@pytest.mark.parametrize("form", ["multiply", "transposed", "gemv"])
def test_fp32_route_within_its_budget_at_k_2048(form):
    """The fp32 route sums in float64 and rounds once: within the 1e-6
    budget of ``ERROR_BUDGETS["highest"]`` where an fp32 SGEMM's
    sequential sums miss it (1.99e-6 at 2048^3 on the card)."""
    r = np.random.RandomState(68)
    a = r.randn(64, 2048).astype(np.float32)
    b = r.randn(2048, 48).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    if form == "multiply":
        got = tmx.matrix_multiply(a, b)
    elif form == "transposed":
        got = tmx.matrix_multiply_transposed(a, b.T.copy())
    else:
        got, want = tmx.matrix_vector_multiply(a, b[:, 0]), want[:, 0]
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= tprx.ERROR_BUDGETS["highest"]


def test_golden_small_gemm():
    m1 = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    m2 = np.array([[5.0, 6.0], [7.0, 8.0]], np.float32)
    np.testing.assert_array_equal(tmx.matrix_multiply(m1, m2).numpy(),
                                  [[19.0, 22.0], [43.0, 50.0]])
    np.testing.assert_array_equal(tmx.matrix_add(m1, m2).numpy(),
                                  [[6.0, 8.0], [10.0, 12.0]])
    np.testing.assert_array_equal(tmx.matrix_sub(m2, m1).numpy(),
                                  [[4.0, 4.0], [4.0, 4.0]])


@pytest.mark.parametrize("call", [
    lambda m, a, b: m.matrix_multiply(a, b),
    lambda m, a, b: m.matrix_multiply_transposed(a, b[:3, :4]),
    lambda m, a, b: m.matrix_multiply(a[0], b),
], ids=["w1_h2", "w1_w2", "ndim"])
def test_shape_contract_violations_match(call):
    a = np.zeros((4, 5), np.float32)
    b = np.zeros((4, 5), np.float32)
    with pytest.raises(ValueError) as jerr:
        call(jmx, a, b)
    with pytest.raises(ValueError) as terr:
        call(tmx, a, b)
    assert str(terr.value) == str(jerr.value)


def test_gemv_matches_jax():
    r = np.random.RandomState(7)
    m = r.randn(300, 256).astype(np.float32)
    v = r.randn(256).astype(np.float32)
    got = tmx.matrix_vector_multiply(m, v)
    assert tuple(got.shape) == (300,)
    want = np.asarray(jmx.matrix_vector_multiply(m, v))
    assert _rel(got.numpy(), want) <= FP32_TOL
    np.testing.assert_allclose(got.numpy(),
                               tmx.matrix_vector_multiply(m, v, simd=False),
                               atol=0.1)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("a_shape,b_shape", [
    ((256, 512), (512, 128)),
    ((17, 9), (9, 13)),             # int8 on the card pads every dim
    ((3, 40, 24), (24, 16)),        # batched a, shared b
    ((2, 3, 33, 17), (3, 17, 5)),   # broadcast batch dims
])
def test_gemm_routes_within_budget_and_match_jax(route, a_shape, b_shape):
    r = np.random.RandomState(59)
    a = r.randn(*a_shape).astype(np.float32)
    b = r.randn(*b_shape).astype(np.float32)
    want = np.matmul(a.astype(np.float64), b.astype(np.float64))
    got = tmx.matrix_multiply(a, b, precision=route).numpy()
    jgot = np.asarray(jmx.matrix_multiply(a, b, precision=route))
    budget = max(tprx.ERROR_BUDGETS[tmx.GEMM_PRECISIONS[route]],
                 FP32_TOL)
    assert got.dtype == np.float32
    assert _rel(got, want) <= budget
    assert _rel(got, jgot) <= budget
    if route == "int8":
        # equal accumulators (test_int8_accumulators_bit_equal); the
        # rescale multiply may round apart by an ulp
        np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=0)


@pytest.mark.parametrize("a_shape,b_shape", [
    ((17, 9), (9, 13)), ((300, 257), (257,)), ((3, 40, 24), (24, 16)),
    ((2, 3, 33, 17), (3, 17, 5)), ((5,), (5, 3))])
def test_int8_accumulators_bit_equal(a_shape, b_shape):
    """Both packages quantize with round-half-to-even and accumulate
    in int32: the accumulators are equal, also where the card's
    ``_int_mm`` needs its zero padding (odd dims, a gemv)."""
    import jax.numpy as jnp

    r = np.random.RandomState(67)
    a = r.randn(*a_shape).astype(np.float32)
    b = r.randn(*b_shape).astype(np.float32)
    qa, sa = tprx._quantize_int8(torch.from_numpy(a))
    qb, sb = tprx._quantize_int8(torch.from_numpy(b))
    jqa, jsa = jprx._quantize_int8(jnp.asarray(a))
    jqb, jsb = jprx._quantize_int8(jnp.asarray(b))
    np.testing.assert_array_equal(qa.numpy(), np.asarray(jqa))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
    assert float(sa) == float(jsa) and float(sb) == float(jsb)
    acc = tprx._int_matmul(qa, qb)
    assert acc.dtype == torch.int32
    want = jnp.matmul(jqa, jqb, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", ROUTES)
def test_transposed_and_gemv_routes(route):
    r = np.random.RandomState(60)
    a = r.randn(128, 512).astype(np.float32)
    bt = r.randn(64, 512).astype(np.float32)
    v = r.randn(512).astype(np.float32)
    budget = max(tprx.ERROR_BUDGETS[tmx.GEMM_PRECISIONS[route]], FP32_TOL)
    got = tmx.matrix_multiply_transposed(a, bt, precision=route).numpy()
    assert _rel(got, a.astype(np.float64) @ bt.T.astype(np.float64)) \
        <= budget
    jgot = jmx.matrix_multiply_transposed(a, bt, precision=route)
    assert _rel(got, np.asarray(jgot)) <= budget
    gv = tmx.matrix_vector_multiply(a, v, precision=route).numpy()
    assert gv.shape == (128,)
    assert _rel(gv, a.astype(np.float64) @ v.astype(np.float64)) <= budget
    jgv = np.asarray(jmx.matrix_vector_multiply(a, v, precision=route))
    if route == "int8":
        np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(gv, jgv, rtol=1e-6, atol=0)


def test_fast_shim_maps_to_bf16_route(telemetry):
    r = np.random.RandomState(61)
    a = r.randn(64, 64).astype(np.float32)
    b = r.randn(64, 64).astype(np.float32)
    with pytest.warns(DeprecationWarning) as rec:
        got = tmx.matrix_multiply(a, b, fast=True)
    # stacklevel points at this line, the caller's
    assert rec[0].filename == __file__
    ev = [e for e in tobs.events()
          if e["op"] == "matrix_precision_route"][-1]
    assert ev["decision"] == "bf16" and ev["forced"]
    np.testing.assert_array_equal(
        got.numpy(), tmx.matrix_multiply(a, b, precision="bf16").numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tmx.matrix_multiply(a, b, fast=True, precision="fp32")


def test_engine_default_is_fp32(telemetry, monkeypatch):
    a = np.random.RandomState(62).randn(64, 64).astype(np.float32)
    monkeypatch.setenv(tprx.INT8_ENV, "1")
    with tobs.span("outer"):
        tmx.matrix_multiply(a, a)
    ev = [e for e in tobs.events()
          if e["op"] == "matrix_precision_route"][-1]
    assert ev["decision"] == "fp32" and not ev["forced"]
    assert ev["h1"] == 64 and ev["t"] == 0
    hists = {h["name"] for h in tobs.snapshot()["histograms"]}
    assert "span.matrix.dispatch" in hists


@pytest.mark.parametrize("bad", ["fp16", "default", "high"])
def test_bad_precision_rejected(bad):
    a = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError) as jerr:
        jmx.matrix_multiply(a, a, precision=bad)
    with pytest.raises(ValueError) as terr:
        tmx.matrix_multiply(a, a, precision=bad)
    assert str(terr.value) == str(jerr.value)


def test_family_registered():
    fam = trouting.get_family("matrix.gemm")
    assert fam.names() == ("fp32", "bf16_comp", "int8", "bf16")


@pytest.mark.parametrize("env", [{}, {"VELES_SIMD_ENABLE_INT8": "1"},
                                 {"VELES_SIMD_DISABLE_BF16_COMP": "1"},
                                 {"VELES_SIMD_ENABLE_INT8": "yes",
                                  "VELES_SIMD_DISABLE_BF16_COMP": "on"}])
def test_eligibility_follows_the_env(monkeypatch, env):
    for name in (tprx.INT8_ENV, tprx.BF16_COMP_ENV):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for p in jprx.PRECISIONS:
        assert tprx.precision_allowed(p) == jprx.precision_allowed(p), p
    want = [n for n in ("fp32", "bf16_comp", "int8")
            if n == "fp32" or jprx.precision_allowed(n)]
    fam = trouting.get_family("matrix.gemm")
    assert fam.eligible(h1=64) == want
    assert fam.select(h1=64) == "fp32"


def test_route_name_round_trip():
    for base in ("rdft_matmul", "xla_fft", "os_matmul"):
        assert tprx.comp_route(base) == jprx.comp_route(base)
        assert tprx.base_route(tprx.comp_route(base)) == base
        assert tprx.base_route(base) == base


# ---- the precision layer's primitives -------------------------------------

def test_split_bf16_matches_jax():
    x = np.random.RandomState(63).randn(4096).astype(np.float32)
    hi, lo = tprx.split_bf16(torch.from_numpy(x))
    jhi, jlo = jprx.split_bf16(x)
    for t, j in ((hi, jhi), (lo, jlo)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    rec = hi.float() + lo.float()
    assert _rel(rec.numpy(), x) < 5e-5


@pytest.mark.parametrize("precision", ["highest", "high", "default",
                                       "bf16", "bf16_comp", "int8"])
@pytest.mark.parametrize("form", ["einsum", "matmul", "dot"])
def test_contractions_within_budget(precision, form):
    r = np.random.RandomState(64)
    a = r.randn(128, 256).astype(np.float32)
    b = r.randn(256, 64).astype(np.float32)
    if form == "dot":
        b = b[:, 0].copy()
    want = a.astype(np.float64) @ b.astype(np.float64)
    at, bt_ = torch.from_numpy(a), torch.from_numpy(b)
    got, jgot = {
        "einsum": lambda: (
            tprx.p_einsum("ij,jk->ik", at, bt_, precision),
            jprx.p_einsum("ij,jk->ik", a, b, precision)),
        "matmul": lambda: (tprx.p_matmul(at, bt_, precision),
                           jprx.p_matmul(a, b, precision)),
        "dot": lambda: (tprx.p_dot(at, bt_, precision),
                        jprx.p_dot(a, b, precision)),
    }[form]()
    budget = max(tprx.ERROR_BUDGETS[precision], FP32_TOL)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= budget
    assert _rel(got.numpy(), np.asarray(jgot)) <= budget
    if precision == "int8":
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot),
                                   rtol=1e-6, atol=0)


def test_bf16_comp_keeps_the_lo_terms():
    """A matmul of two bf16 tensors in torch returns bf16, which would
    round the residual terms away: each pass here returns float32, so
    the compensated product beats plain bf16 by 10x on a
    large-dynamic-range input (the JAX layer's own gate)."""
    r = np.random.RandomState(65)
    a = (r.randn(256, 256) * 10.0 ** r.uniform(-3, 3, (256, 256)))
    b = (r.randn(256, 256) * 10.0 ** r.uniform(-3, 3, (256, 256)))
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    at, bt_ = torch.from_numpy(a), torch.from_numpy(b)
    comp = tprx.p_matmul(at, bt_, "bf16_comp")
    assert comp.dtype == torch.float32
    err_comp = _rel(comp.numpy(), want)
    err_bf16 = _rel(tprx.p_matmul(at, bt_, "bf16").numpy(), want)
    assert err_comp * 10 <= err_bf16
    assert err_comp <= tprx.ERROR_BUDGETS["bf16_comp"]


def test_matmul_precision_setting_restored():
    prev = torch.get_float32_matmul_precision()
    a = torch.ones(8, 8)
    for p in tprx.PRECISIONS:
        tprx.p_matmul(a, a, p)
        assert torch.get_float32_matmul_precision() == prev
    with pytest.raises(ValueError, match="precision"):
        tprx.p_matmul(a, a, "fp64")


@pytest.mark.parametrize("precision", ["highest", "default", "bf16",
                                       "bf16_comp", "int8"])
@pytest.mark.parametrize("dims", [1, 2])
def test_p_conv_within_budget(precision, dims):
    r = np.random.RandomState(66)
    if dims == 1:
        x = r.randn(4, 1, 300).astype(np.float32)
        w = r.randn(2, 1, 31).astype(np.float32)
        jkw = dict(window_strides=(2,), padding=[(3, 3)])
        tkw = dict(stride=2, padding=3)
        lhs_dn = ("NCH", "OIH", "NCH")
    else:
        x = r.randn(2, 1, 40, 50).astype(np.float32)
        w = r.randn(3, 1, 5, 7).astype(np.float32)
        jkw = dict(window_strides=(1, 1), padding="VALID")
        tkw = {}
        lhs_dn = ("NCHW", "OIHW", "NCHW")
    got = tprx.p_conv(torch.from_numpy(x), torch.from_numpy(w),
                      precision, **tkw)
    want = tprx.p_conv(torch.from_numpy(x.astype(np.float64)),
                       torch.from_numpy(w.astype(np.float64)),
                       "highest", **tkw).numpy()
    jgot = jprx.p_conv(x, w, precision, dimension_numbers=lhs_dn, **jkw)
    budget = max(tprx.ERROR_BUDGETS[precision], FP32_TOL)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= budget
    assert _rel(got.numpy(), np.asarray(jgot)) <= budget


# ---- the GEMM bound --------------------------------------------------------

def test_gemm_work_and_bounds():
    flops, nbytes = tbench.gemm_work(2048, 2048, 2048)
    assert flops == 2.0 * 2048 ** 3
    assert nbytes == 4.0 * 3 * 2048 ** 2
    assert tbench.gemm_work(4, 5, 6, rows=3) == (
        2.0 * 3 * 4 * 5 * 6, 4.0 * 3 * (20 + 30 + 24))
    ms32, by32 = tbench.gemm_bound(flops, nbytes, "highest")
    assert by32 == "operations"
    assert ms32 == pytest.approx(flops / 67e12 * 1e3)
    assert ms32 == tbench.fp32_bound(flops, nbytes)[0]
    comp = tbench.gemm_bound(flops, nbytes, "bf16_comp")[0]
    bf16 = tbench.gemm_bound(flops, nbytes, "bf16")[0]
    assert comp == pytest.approx(3 * bf16)
    assert bf16 == pytest.approx(flops / 989e12 * 1e3)
    # int8 at 2048: the float32 operands' bytes outlast the int8 rate
    assert tbench.gemm_bound(flops, nbytes, "int8") == pytest.approx(
        (nbytes / 3.35e12 * 1e3, "bytes"))
    assert tbench.gemm_bound(4 * flops, nbytes, "int8")[0] == \
        pytest.approx(4 * flops / 1979e12 * 1e3)
    assert tbench.gemm_bound(flops, nbytes, "default")[0] == \
        pytest.approx(flops / 495e12 * 1e3)
    # a gemv moves its matrix once: the bytes set its bound
    assert tbench.gemm_bound(*tbench.gemm_work(512, 512, 1),
                             "highest")[1] == "bytes"
    with pytest.raises(ValueError):
        tbench.gemm_bound(flops, nbytes, "fp64")


def test_gemm_routes_on_a_cuda_tensor_need_the_card():
    """The device rule: the default config asks for the card, and the
    port never carries on on the CPU without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tconfig.set_config(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tmx.matrix_multiply(np.ones((2, 2), np.float32),
                            np.ones((2, 2), np.float32))


@pytest.mark.parametrize("v_shape", [(5,), (5, 2), (3,)])
def test_gemv_mismatch_raises_the_jax_class(v_shape):
    # F4: a vector that does not match the matrix raises TypeError in
    # both packages (torch alone would raise RuntimeError), checked
    # before any torch call
    m = np.ones((3, 4), np.float32)
    v = np.ones(v_shape, np.float32)
    with pytest.raises(TypeError) as want:
        jmx.matrix_vector_multiply(m, v, simd=True)
    with pytest.raises(TypeError) as got:
        tmx.matrix_vector_multiply(m, v, simd=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["matrix_add", "matrix_sub"])
def test_add_sub_mismatch_raises_the_jax_class(name):
    # F14: operands that do not broadcast raise TypeError in both
    # packages (torch alone would raise RuntimeError), checked before
    # any torch call; the NumPy twins raise NumPy's ValueError alike
    a = np.ones((2, 3), np.float32)
    b = np.ones((3, 2), np.float32)
    with pytest.raises(TypeError) as want:
        getattr(jmx, name)(a, b, simd=True)
    with pytest.raises(TypeError) as got:
        getattr(tmx, name)(a, b, simd=True)
    assert str(got.value) == str(want.value)
    for mod in (jmx, tmx):
        with pytest.raises(ValueError):
            getattr(mod, name)(a, b, simd=False)
