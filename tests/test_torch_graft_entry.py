"""The port's flagship step (``graft_entry_torch.py``) against the JAX
package's (``__graft_entry__.py``).

The same seeded NumPy inputs go through ``jax.jit(_pipeline)`` and
``jax.value_and_grad`` of the JAX step's loss (on the conftest's CPU
platform) and through the port's ``_pipeline``, ``train_step`` and
``sharded_train_step`` under ``set_config(device="cpu")``.  Held:

* the features within 1e-5 of max|feats|, the peak mask exactly;
* the loss within 1e-5 relative, each updated parameter within 1e-5 of
  its max, for one step and for three chained steps;
* the sharded step on 8, 4, 2 and 1 ``cpu`` shards equal to the
  one-device step within 1e-5 of max (sp shards repeat the step, and
  no sum runs over them);
* ``dryrun_multichip(8)``: every sharded check of the JAX dry run, and
  its loss equal to the JAX step's at the dry run's seed and sizes;
* the file as a script with ``VELES_SIMD_PLATFORM=cpu``.
"""

import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jge
from veles.simd_tpu_torch import parallel as tpar
from veles.simd_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
LR = 0.01
# (batch, n, k, f, seed): entry()'s width and a small one
SHAPES = [(8, 4096, 129, 64, 0), (4, 256, 17, 8, 1)]
SHAPE_IDS = ["entry", "small"]


def _module():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_torch", REPO / "graft_entry_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ge = _module()


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _inputs(batch, n, k, f, seed):
    """``(params, x, target)`` as NumPy, in entry()'s draw order."""
    rng = np.random.RandomState(seed)
    params = {
        "filter": rng.randn(k).astype(np.float32) * 0.1,
        "proj": rng.randn(f, n // 2).astype(np.float32) * (n // 2) ** -0.5,
    }
    x = rng.randn(batch, n).astype(np.float32)
    target = rng.randn(batch, f).astype(np.float32)
    return params, x, target


def _jax_step(params, x, target):
    """The JAX dry run's step on one device: ``(loss, new_params)``."""
    def loss_fn(p, x, target):
        feats, _ = jge._pipeline(p, x)
        return jnp.mean((feats - target) ** 2)

    @jax.jit
    def step(p, x, target):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, target)
        return loss, jax.tree.map(lambda a, g: a - LR * g, p, grads)

    return step(params, x, target)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def _params_close(port, ref):
    port = ge.params_to_numpy(port)
    for name in ("filter", "proj"):
        assert _rel(port[name], np.asarray(ref[name])) <= TOL, name


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_pipeline_matches_jax(shape):
    params, x, _ = _inputs(*shape)
    jfeats, jmask = jax.jit(jge._pipeline)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    feats, mask = ge._pipeline(ge.params_from_jax(params),
                               torch.as_tensor(x))
    assert feats.dtype == torch.float32 and mask.dtype == torch.bool
    assert _rel(feats.detach().numpy(), np.asarray(jfeats)) <= TOL
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_entry_args_equal_the_jax_args_bit_for_bit():
    fn, (params, x) = ge.entry()
    jfn, (jparams, jx) = jge.entry()
    assert fn is ge._pipeline
    assert x.device.type == "cpu" and x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert list(params) == list(jparams)
    for name in params:
        assert params[name].dtype == torch.float32
        np.testing.assert_array_equal(params[name].numpy(),
                                      np.asarray(jparams[name]))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_train_step_matches_jax_value_and_grad(shape):
    params, x, target = _inputs(*shape)
    jloss, jnew = _jax_step(params, x, target)
    tparams = ge.params_from_jax(params)
    before = {k: v.clone() for k, v in tparams.items()}
    loss, new = ge.train_step(tparams, torch.as_tensor(x),
                              torch.as_tensor(target), lr=LR)
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    _params_close(new, jnew)
    assert not any(p.requires_grad for p in new.values())
    # the caller's tensors are left as they were
    for name in before:
        assert torch.equal(tparams[name], before[name])


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_three_chained_steps_match_three_jax_steps(shape):
    params, x, target = _inputs(*shape)
    tparams = ge.params_from_jax(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for _ in range(3):
        jloss, jparams = _jax_step(jparams, x, target)
        loss, tparams = ge.train_step(tparams, torch.as_tensor(x),
                                      torch.as_tensor(target), lr=LR)
        assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
        _params_close(tparams, jparams)


def test_train_step_lowers_the_loss_at_entry_width():
    _, (params, x) = ge.entry()
    target = torch.as_tensor(
        np.random.RandomState(2).randn(8, 64).astype(np.float32))
    losses = []
    for _ in range(5):
        loss, params = ge.train_step(params, x, target)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_params_round_trip_through_numpy():
    params, _, _ = _inputs(4, 256, 17, 8, 3)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = ge.params_from_jax(jparams)
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in tparams.values())
    back = ge.params_to_numpy(tparams)
    assert list(back) == ["filter", "proj"]
    for name in params:
        assert isinstance(back[name], np.ndarray)
        np.testing.assert_array_equal(back[name], params[name])


@pytest.mark.parametrize("n", range(1, 65))
def test_factor_axes_matches_jax(n):
    axes = ge._factor_axes(n)
    assert axes == jge._factor_axes(n)
    assert int(np.prod(axes)) == n


@pytest.mark.parametrize("axes", [(2, 2, 2), (2, 2, 1), (2, 1, 1),
                                  (1, 1, 1), (1, 4, 2)],
                         ids=["8", "4", "2", "1", "1x4x2"])
def test_sharded_train_step_equals_the_one_device_step(axes):
    dp, sp, tp = axes
    params, x, target = _inputs(4, 256, 17, 8, 4)
    mesh = tpar.make_mesh({"dp": dp, "sp": sp, "tp": tp},
                          devices=["cpu"] * (dp * sp * tp))
    tparams = ge.params_from_jax(params)
    loss1, new1 = ge.train_step(tparams, torch.as_tensor(x),
                                torch.as_tensor(target))
    loss, new = ge.sharded_train_step(tparams, torch.as_tensor(x),
                                      torch.as_tensor(target), mesh)
    assert loss.shape == () and new["filter"].shape == (17,)
    assert new["proj"].shape == (8, 128)
    # an sp-fold sum would scale the loss and the step by sp
    assert abs(float(loss) - float(loss1)) <= TOL * abs(float(loss1))
    for name in ("filter", "proj"):
        assert _rel(new[name].numpy(), new1[name].numpy()) <= TOL, name


def test_dryrun_multichip_matches_the_jax_step(capsys):
    loss = ge.dryrun_multichip(8)
    assert np.isfinite(loss)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"dryrun_multichip: mesh dp=2 sp=2 tp=2 loss={loss:.4f} ok"
    # the JAX dry run's step at its seed and sizes (__graft_entry__.py
    # :104-117): dp 2, tp 2
    rng = np.random.RandomState(1)
    batch, n, k, f = 4, 256, 17, 8
    params = {
        "filter": rng.randn(k).astype(np.float32) * 0.1,
        "proj": rng.randn(f, n // 2).astype(np.float32) * 0.05,
    }
    x = rng.randn(batch, n).astype(np.float32)
    target = rng.randn(batch, f).astype(np.float32)
    jloss, _ = _jax_step(params, x, target)
    assert abs(loss - float(jloss)) <= TOL * abs(float(jloss))


def test_script_runs_on_the_cpu():
    env = dict(os.environ, VELES_SIMD_PLATFORM="cpu")
    out = subprocess.run([sys.executable, str(REPO / "graft_entry_torch.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert "entry(): ((8, 64), (8, 4096))" in lines
    assert re.fullmatch(r"dryrun_multichip: mesh dp=2 sp=2 tp=2 "
                        r"loss=\d+\.\d{4} ok", lines[-1]), lines[-1]
