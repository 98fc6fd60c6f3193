"""The check that decides ``correct``, driven through a whole run on the
CPU at small sizes: a sound run passes; the control (the reference one
precision lower, in the program's place) and each fault that these
cells can have, planted under the timed path, fail."""

import time

import pytest
import torch

from cellbench import harness

SMALL = {"conv1d_1m.taps2047": {"rows": 4, "n": 4096, "taps": 300},
         "conv1d_1m.taps129": {"rows": 4, "n": 4096, "taps": 129},
         "dwt_daub8.rows16384": {"rows": 16, "n": 512},
         "dwt_daub8.rows4": {"rows": 4, "n": 2048}}
CELLS = sorted(SMALL)


def _run(name, seed, wrap=None, control=False):
    cell = harness.load_cell(name)
    return harness.run(cell, seed, 0.2, False, "cpu", time.perf_counter(),
                       wrap=wrap, params=SMALL[name], control=control)


def _map(out, fn):
    return fn(out) if isinstance(out, torch.Tensor) else [fn(t) for t in out]


def stale(entry):
    """The previous call's answer (zeros for the first): a step that
    hands back its state unchanged."""
    last = {}

    def call(**operands):
        out = entry(**operands)
        prev = last.get("out", _map(out, torch.zeros_like))
        last["out"] = out
        return prev
    return call


def half_batch(entry):
    """Half of the rows left out (zeros where they belong)."""
    def call(**operands):
        def cut(t):
            t = t.clone()
            t[t.shape[0] // 2:] = 0
            return t
        return _map(entry(**operands), cut)
    return call


def altered(entry):
    """One answer altered where it is produced: one output value a
    thousandth of the output's range off."""
    def call(**operands):
        out = entry(**operands)
        first = out if isinstance(out, torch.Tensor) else out[0]
        first = first.clone()
        first[0, first.shape[1] // 2] += 1e-3 * float(first.abs().max())
        return first if isinstance(out, torch.Tensor) else [first, *out[1:]]
    return call


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line = _run(name, 2 ** 31 + 17)
    assert line["correct"] is True
    assert line["calls_compared"] == 8
    check = line["check"]["max_rel_err"]
    assert check["value"] < check["limit"]
    assert list(line)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5, 4_000_000_007])
def test_the_control_fails_the_limit(name, seed):
    line = _run(name, seed, control=True)
    assert line["correct"] is True
    limit = line["check"]["max_rel_err"]["limit"]
    assert line["control"]["max_rel_err"] > 3 * limit


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [stale, half_batch, altered])
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    line = _run(name, 2 ** 31 + 99, wrap=fault)
    assert line["correct"] is False
    assert line["check"]["max_rel_err"]["value"] > \
        line["check"]["max_rel_err"]["limit"]


def test_the_sample_is_drawn_from_the_seed():
    def kept(seed):
        r = harness.Reservoir(seed, 4)
        for i in range(1000):
            r.offer(i, i)
        return [i for i, _ in r.kept]
    assert kept(5) == kept(5)
    assert kept(5) != kept(6)
    assert all(0 <= i < 1000 for i in kept(7)) and max(kept(7)) > 4


def test_the_same_seed_gives_the_same_operands():
    spec = {"x": {"shape": ["rows", "n"], "pool": True},
            "h": {"shape": ["taps"], "pool": False}}
    params = {"rows": 2, "n": 16, "taps": 3}
    a = harness.make_operands(spec, params, 2 ** 33 + 1, 3, "cpu")
    b = harness.make_operands(spec, params, 2 ** 33 + 1, 3, "cpu")
    c = harness.make_operands(spec, params, 2 ** 33 + 2, 3, "cpu")
    assert all(torch.equal(x["x"], y["x"]) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1]["h"], b[1]["h"])
    assert not torch.equal(a[0][0]["x"], c[0][0]["x"])
    assert not torch.equal(a[0][0]["x"], a[0][1]["x"])
