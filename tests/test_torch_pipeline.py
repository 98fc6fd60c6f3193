"""The port's pipeline compiler against the JAX package's.

Every chain that ``tests/test_pipeline.py`` builds runs through both
packages on the same seeded NumPy input, at three block sizes or more:
the port's ``stream`` is held to the JAX package's ``stream`` and to its
one-shot ``oracle`` within 1e-5 of max|y| (that file's ``_rel`` bound;
the terminal peak values within its 1e-4).  Also: a stream split at a
block boundary continues in the other package; ``describe()``,
``routes()``, the declaration errors and ``pipeline_from_spec`` agree;
the one-dispatch checks, the unfused entries and the four fault cases
of ``tests/test_pipeline.py``, plus the card-operand rule (no oracle).

On the CPU the step runs eagerly once per block; the CUDA-graph step is
held to it in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

from veles.simd_tpu import obs as jobs
from veles.simd_tpu import pipeline as jpl
from veles.simd_tpu.ops import iir as jiir
from veles.simd_tpu.runtime import faults as jfaults
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch import pipeline as tpl
from veles.simd_tpu_torch.ops import iir as tiir
from veles.simd_tpu_torch.ops import resample as trs
from veles.simd_tpu_torch.ops import spectral as tsp
from veles.simd_tpu_torch.pipeline import compiler as tcomp
from veles.simd_tpu_torch.pipeline import stages as tstages
from veles.simd_tpu_torch.runtime import breaker, faults
from veles.simd_tpu_torch.utils import config

SOS = jiir.butterworth(4, 0.25, "lowpass")
H1031 = np.random.RandomState(3).randn(1031).astype(np.float32)
H63 = np.random.RandomState(4).randn(63).astype(np.float32)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    prev = config.get_config()
    config.set_config(device="cpu")
    monkeypatch.setenv("VELES_SIMD_FAULT_BACKOFF", "0")
    faults.reset_fault_history()
    jfaults.reset_fault_history()
    yield
    faults.set_fault_plan(None)
    jfaults.set_fault_plan(None)
    faults.reset_fault_history()
    jfaults.reset_fault_history()
    config.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def telemetry():
    obs.enable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) or 1.0
    return float(np.max(np.abs(got - want)) / scale)


def _np(tree):
    """A state or output tree as NumPy (either package's)."""
    if isinstance(tree, (tuple, list)):
        return tuple(_np(t) for t in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


# every chain of tests/test_pipeline.py, by name: (stages of a package,
# block sizes, the leading batch shape)
CHAINS = {
    "sensor": (lambda m: [m.resample_poly(2, 1), m.sosfilt(SOS),
                          m.stft(256, 64), m.power()],
               (320, 512, 1024), ()),
    "sensor_batched": (lambda m: [m.resample_poly(2, 1), m.sosfilt(SOS),
                                  m.stft(256, 64), m.power()],
                       (256, 512, 1024), (3,)),
    "firline": (lambda m: [m.fir(H1031)], (256, 512, 1024), ()),
    "fircheck": (lambda m: [m.fir(H63)], (128, 256, 512), ()),
    "matched": (lambda m: [m.matched_filter(H63)], (128, 256, 512), (2,)),
    "rs2_1": (lambda m: [m.resample_poly(2, 1)], (256, 512, 588), ()),
    "rs1_2": (lambda m: [m.resample_poly(1, 2)], (256, 512, 588), ()),
    "rs3_2": (lambda m: [m.resample_poly(3, 2)], (256, 512, 588), ()),
    "rs160_147": (lambda m: [m.resample_poly(160, 147)],
                  (294, 588, 1176), ()),
    "rs2_4": (lambda m: [m.resample_poly(2, 4)], (64, 128, 256), ()),
    "sosline": (lambda m: [m.sosfilt(SOS)], (128, 256, 2048), ()),
    "stftline": (lambda m: [m.stft(256, 64)], (64, 256, 1024), ()),
    "monitor": (lambda m: [m.medfilt(5), m.detrend("linear"),
                           m.sosfilt(SOS),
                           m.welch(fs=2000.0, nperseg=256),
                           m.power_db(), m.savgol(7, 2),
                           m.detect_peaks(max_peaks=16)],
                (256, 512, 1024), ()),
}


def _both(name, block, stages=None):
    make = stages or CHAINS[name][0]
    return (jpl.Pipeline(make(jpl), name=name).compile(block),
            tpl.Pipeline(make(tpl), name=name).compile(block))


def _signal(name, block, blocks=4):
    lead = CHAINS[name][2]
    r = np.random.RandomState(block + len(name))
    return r.randn(*lead, blocks * block).astype(np.float32)


def _check_terminal(got, want):
    g_pos, g_vals, g_count = (np.asarray(v) for v in got)
    pos, vals, count = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(g_pos, pos)
    np.testing.assert_array_equal(g_count, count)
    assert _rel(g_vals[g_pos >= 0], vals[pos >= 0]) <= 1e-4


@pytest.mark.parametrize("name,block", [
    (name, block) for name, (_, blocks, _) in CHAINS.items()
    for block in blocks])
def test_stream_matches_jax_stream_and_oracle(name, block):
    jcp, tcp = _both(name, block)
    x = _signal(name, block)
    got, _ = tcp.stream(x)
    want_stream, _ = jcp.stream(x)
    want_oracle = jcp.oracle(x)
    if tcp.terminal_tree:
        _check_terminal(got, want_stream)
        _check_terminal(got, want_oracle)
        return
    assert isinstance(got, np.ndarray)
    assert _rel(got, want_stream) <= TOL
    assert _rel(got, want_oracle) <= TOL
    assert _rel(tcp.oracle(x), want_oracle) <= 1e-12


@pytest.mark.parametrize("name", ["sensor", "firline", "rs160_147",
                                  "monitor", "sensor_batched"])
def test_describe_and_routes_equal_jax(name):
    block = CHAINS[name][1][1]
    jcp, tcp = _both(name, block)
    assert tcp.describe() == jcp.describe()
    assert tcp.routes() == jcp.routes()
    assert (tcp.out_block, tcp.mode, tcp.terminal_tree) == (
        jcp.out_block, jcp.mode, jcp.terminal_tree)


# ---------------------------------------------------------------------------
# carried state crosses between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sensor", "firline", "rs3_2",
                                  "monitor", "sensor_batched"])
@pytest.mark.parametrize("first", ["jax", "torch"])
def test_state_crosses_between_packages(name, first):
    block = CHAINS[name][1][1]
    jcp, tcp = _both(name, block)
    x = _signal(name, block, blocks=6)
    blocks = [x[..., i:i + block] for i in range(0, x.shape[-1], block)]
    lead = CHAINS[name][2]
    a, b = (jcp, tcp) if first == "jax" else (tcp, jcp)
    outs, state = [], a.init_state(lead)
    for blk in blocks[:3]:
        out, state = a.process(blk, state)
        outs.append(_np(out))
    state = _np(state)
    for blk in blocks[3:]:
        out, state = b.process(blk, state)
        outs.append(_np(out))
    got = tcp.assemble(outs)
    want = jcp.oracle(x)
    if tcp.terminal_tree:
        _check_terminal(got, want)
    else:
        assert _rel(got, want) <= TOL


def test_state_roundtrips_through_numpy_marshalling():
    _, cp = _both("sensor", 512)
    x = _signal("sensor", 512)
    state, outs = None, []
    for i in range(4):
        out, state = cp.process(x[i * 512:(i + 1) * 512], state)
        batched = cp.batch_states([state], 2)
        state = cp.state_rows(batched, 1)[0]
        outs.append(out)
    assert _rel(cp.assemble(outs), cp.oracle(x)) <= TOL


def test_recompiling_pipeline_never_corrupts_earlier():
    chain = tpl.Pipeline([tpl.resample_poly(2, 4)], name="recompile")
    cp1 = chain.compile(128, name="rc128")
    x = np.random.RandomState(5).randn(256).astype(np.float32)
    want = cp1.oracle(x)
    cp2 = chain.compile(64, name="rc64")
    got, _ = cp1.stream(x)
    assert cp1.block_len == 128 and cp2.block_len == 64
    assert got.shape == want.shape == (128,)
    assert _rel(got, want) <= TOL


def test_resample_preroll_aligns_with_one_shot():
    cp = tpl.Pipeline([tpl.resample_poly(2, 1)],
                      name="rsalign").compile(512)
    x = np.random.RandomState(6).randn(4096).astype(np.float32)
    got, _ = cp.stream(x)
    lat = cp.describe()["stages"][0]["latency"]
    one = np.asarray(trs.resample_poly_na(x.astype(np.float64), 2, 1))
    assert lat > 0
    assert _rel(got[lat:], one[:len(got) - lat]) <= TOL


def test_sosfilt_and_stft_lines_match_one_shot():
    x = np.random.RandomState(7).randn(4096).astype(np.float32)
    want = tiir.sosfilt_na(SOS, x.astype(np.float64))
    for b in (128, 256, 2048):
        got, _ = tpl.Pipeline([tpl.sosfilt(SOS)], name=f"sos{b}"
                              ).compile(b).stream(x)
        assert _rel(got, want) <= TOL
    want = tsp.stft_stream_oracle(x, 256, 64)
    for b in (64, 256, 1024):
        got, _ = tpl.Pipeline([tpl.stft(256, 64)], name=f"stft{b}"
                              ).compile(b).stream(x)
        assert _rel(got, want) <= TOL


def test_outputs_and_states_are_tensors_on_the_device():
    import torch

    _, cp = _both("sensor", 512)
    out, state = cp.process(np.zeros(512, np.float32))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert all(isinstance(s, torch.Tensor) for s in state
               if not isinstance(s, tuple))
    assert isinstance(cp.init_state()[0], np.ndarray)


# ---------------------------------------------------------------------------
# declaration errors: same class, same message, both packages
# ---------------------------------------------------------------------------

DECLARATIONS = {
    "empty": (lambda m: m.Pipeline([]), ValueError, "at least one stage"),
    "terminal": (lambda m: m.Pipeline([m.detect_peaks(max_peaks=4),
                                       m.sosfilt(SOS)]),
                 ValueError, "terminal"),
    "duplicate": (lambda m: m.Pipeline([m.sosfilt(SOS), m.sosfilt(SOS)]),
                  ValueError, "duplicate"),
    "not_a_stage": (lambda m: m.Pipeline(["stft"]), TypeError,
                    "not a pipeline stage"),
    "resample_rate": (lambda m: m.Pipeline([m.resample_poly(3, 2)]
                                           ).compile(511),
                      ValueError, "divisible"),
    "stft_hop": (lambda m: m.Pipeline([m.stft(256, 64)]).compile(100),
                 ValueError, "hop"),
    "savgol_samples": (lambda m: m.Pipeline([m.savgol(7, 2)]
                                            ).compile(512),
                       ValueError, "per-row"),
    "savgol_interp": (lambda m: m.savgol(7, 2, mode="interp"),
                      ValueError, "interp"),
    "after_rows": (lambda m: m.Pipeline([m.welch(nperseg=128),
                                         m.sosfilt(SOS)]).compile(512),
                   ValueError, "samples"),
    "welch_short": (lambda m: m.Pipeline([m.welch(nperseg=256)]
                                         ).compile(128),
                    ValueError, "nperseg"),
    "sosfilt_block": (lambda m: m.Pipeline([m.sosfilt(SOS)]).compile(1),
                      ValueError, "blocks >= 2"),
    "block_len": (lambda m: m.Pipeline([m.sosfilt(SOS)]).compile(0),
                  ValueError, "block_len"),
    "detrend_type": (lambda m: m.detrend("quadratic"), ValueError,
                     "linear"),
    "peaks_max": (lambda m: m.detect_peaks(max_peaks=0), ValueError,
                  "max_peaks"),
    "medfilt_even": (lambda m: m.medfilt(4), ValueError, "odd"),
}


@pytest.mark.parametrize("case", sorted(DECLARATIONS))
def test_declaration_errors_match_jax(case):
    build, cls, match = DECLARATIONS[case]
    with pytest.raises(cls, match=match) as want:
        build(jpl)
    with pytest.raises(cls, match=match) as got:
        build(tpl)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_wrong_block_length_rejected_at_process():
    cp = tpl.Pipeline([tpl.sosfilt(SOS)]).compile(256)
    with pytest.raises(ValueError, match="block length"):
        cp.process(np.zeros(128, np.float32))


def test_stream_rejects_partial_blocks():
    cp = tpl.Pipeline([tpl.sosfilt(SOS)]).compile(256)
    with pytest.raises(ValueError, match="whole blocks"):
        cp.stream(np.zeros(300, np.float32))


def test_check_state_rejects_foreign_states():
    jcp, tcp = _both("sosline", 256)
    for cp in (jcp, tcp):
        cp.check_state(cp.init_state())
        with pytest.raises(ValueError, match="shape"):
            cp.check_state((np.zeros((3, 2), np.float32),))
        with pytest.raises(ValueError, match="tuple"):
            cp.check_state(np.zeros(4, np.float32))


# ---------------------------------------------------------------------------
# pipeline_from_spec: one JSON spec, one chain, both packages
# ---------------------------------------------------------------------------

SPEC = {"name": "spec_sensor", "block": 512, "stages": [
    {"stage": "resample_poly", "up": 2, "down": 1},
    {"stage": "sosfilt", "sos": SOS.tolist()},
    {"stage": "stft", "frame_length": 256, "hop": 64},
    {"stage": "power"}]}


def test_pipeline_from_spec_builds_the_same_chain():
    jcp = jpl.pipeline_from_spec(SPEC)
    tcp = tpl.pipeline_from_spec(SPEC)
    assert tcp.describe() == jcp.describe()
    assert sorted(tpl.SPEC_FACTORIES) == sorted(jpl.SPEC_FACTORIES)
    x = np.random.RandomState(8).randn(2048).astype(np.float32)
    assert _rel(tcp.stream(x)[0], jcp.stream(x)[0]) <= TOL


@pytest.mark.parametrize("spec", [
    [], {"name": "", "block": 1, "stages": [{"stage": "power"}]},
    {"name": "a", "block": "x", "stages": [{"stage": "power"}]},
    {"name": "a", "block": 8, "stages": []},
    {"name": "a", "block": 8, "stages": [{"nope": 1}]},
    {"name": "a", "block": 8, "stages": [{"stage": "bogus"}]},
    {"name": "a", "block": 8, "stages": [{"stage": "medfilt",
                                          "kernel_size": 4}]},
], ids=["not_dict", "no_name", "bad_block", "no_stages", "no_key",
        "unknown", "bad_kwargs"])
def test_malformed_specs_raise_like_jax(spec):
    with pytest.raises(ValueError) as want:
        jpl.pipeline_from_spec(spec)
    with pytest.raises(ValueError) as got:
        tpl.pipeline_from_spec(spec)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# ONE step per block
# ---------------------------------------------------------------------------

def test_single_step_single_span_per_block(telemetry):
    cp = tpl.Pipeline(CHAINS["sensor"][0](tpl), name="fuseproof"
                      ).compile(512)
    x = np.random.RandomState(9).randn(8 * 512).astype(np.float32)
    blocks = [x[i:i + 512] for i in range(0, len(x), 512)]
    state = cp.init_state()
    out, state = cp.process(blocks[0], state)
    size_after_warmup = cp.compile_cache_size()
    obs.reset()
    for b in blocks[1:]:
        out, state = cp.process(b, state)
    assert size_after_warmup == 1
    assert cp.compile_cache_size() == 1
    spans = [e for e in obs.trace_events()
             if e.get("name") == "pipeline.dispatch"]
    assert len(spans) == len(blocks) - 1
    assert all(e["args"]["fused"] for e in spans)
    # steady state records at most the one step: the stages run inside
    # it, never as entries of their own
    assert {(r["op"], r["route"]) for r in obs.resources()} <= {
        ("pipeline", "fuseproof")}


def test_resources_single_pipeline_entry(telemetry):
    cp = tpl.Pipeline(CHAINS["sensor"][0](tpl), name="resproof"
                      ).compile(512)
    cp.stream(np.random.RandomState(10).randn(1024).astype(np.float32))
    rows = obs.resources()
    assert {(r["op"], r["route"]) for r in rows} == {
        ("pipeline", "resproof")}
    assert rows[0]["shapes"].startswith("float32[512]")
    assert rows[0]["peak_bytes"] is None      # no card: no device peak


def test_unfused_dispatches_per_stage(telemetry):
    cp = tpl.Pipeline(CHAINS["sensor"][0](tpl), name="unfused"
                      ).compile(512)
    x = np.random.RandomState(11).randn(1024).astype(np.float32)
    got, _ = cp.stream(x, fused=False)
    assert {r["op"] for r in obs.resources()} == {"pipeline_stage"}
    assert {r["route"] for r in obs.resources()} == {
        "unfused:resample_poly", "unfused:sosfilt", "unfused:stft",
        "unfused:power"}
    fused, _ = cp.stream(x)
    assert _rel(got, fused) <= 1e-6


def test_compile_cache_counts_batch_shapes():
    _, cp = _both("sosline", 256)
    cp.stream(np.zeros(512, np.float32))
    assert cp.compile_cache_size() == 1
    cp.stream(np.zeros((2, 512), np.float32))
    assert cp.compile_cache_size() == 2
    assert "pipeline_graphs" in obs.caches()


def test_compile_records_decisions_like_jax(telemetry):
    jobs.enable(compile_listeners=False)
    jobs.reset()
    try:
        jcp, tcp = _both("sensor", 512)
        want = [(e["op"], e["decision"]) for e in jobs.events()
                if e["op"].startswith("pipeline")]
    finally:
        jobs.disable()
        jobs.reset()
    got = [(e["op"], e["decision"]) for e in obs.events()
           if e["op"].startswith("pipeline")]
    assert got == want == [("pipeline_stage_route", "rdft_matmul"),
                           ("pipeline_compile", "sensor")]


# ---------------------------------------------------------------------------
# fault injection at pipeline.dispatch
# ---------------------------------------------------------------------------

def test_mid_stream_fault_degrades_one_block(telemetry):
    _, cp = _both("sensor", 512)
    x = _signal("sensor", 512, blocks=6)
    state, outs = cp.init_state(), []
    for i in range(6):
        b = x[i * 512:(i + 1) * 512]
        if i == 2:
            with faults.fault_plan("pipeline.dispatch:device_lost:99"):
                out, state = cp.process(b, state)
            assert isinstance(out, np.ndarray)      # the oracle's answer
        else:
            out, state = cp.process(b, state)
        outs.append(out)
    assert _rel(cp.assemble(outs), cp.oracle(x)) <= TOL
    assert obs.counter_value("fault_degraded", site="pipeline.dispatch",
                             to="oracle") == 1


def test_transient_fault_retries_then_succeeds(telemetry):
    cp = tpl.Pipeline([tpl.sosfilt(SOS)], name="retryline").compile(256)
    x = np.random.RandomState(12).randn(256).astype(np.float32)
    cp.process(x)
    with faults.fault_plan("pipeline.dispatch:device_lost:1"):
        cp.process(x)
    assert obs.counter_value("fault_retry", site="pipeline.dispatch") == 1
    assert obs.counter_value("fault_degraded", site="pipeline.dispatch",
                             to="oracle") == 0


def test_persistent_fault_opens_pipeline_breaker(telemetry):
    cp = tpl.Pipeline([tpl.sosfilt(SOS)], name="poisonline").compile(256)
    x = np.random.RandomState(13).randn(256).astype(np.float32)
    state = None
    with faults.fault_plan("pipeline.dispatch:device_lost:9999"):
        for _ in range(6):
            _, state = cp.process(x, state)
    br = breaker.lookup("pipeline.dispatch", ("poisonline", 256))
    assert br is not None and br.state == breaker.OPEN
    before = obs.counter_value("fault_retry", site="pipeline.dispatch")
    with faults.fault_plan("pipeline.dispatch:device_lost:9999"):
        cp.process(x, state)
    assert obs.counter_value("fault_retry",
                             site="pipeline.dispatch") == before


def test_subsite_poisons_one_pipeline_only(telemetry):
    cp_a = tpl.Pipeline([tpl.sosfilt(SOS)], name="pa").compile(256)
    cp_b = tpl.Pipeline([tpl.sosfilt(SOS)], name="pb").compile(256)
    x = np.random.RandomState(14).randn(256).astype(np.float32)
    cp_a.process(x)
    cp_b.process(x)
    with faults.fault_plan("pipeline.dispatch@pa:device_lost:9999"):
        for _ in range(4):
            cp_a.process(x)
        cp_b.process(x)
    assert obs.counter_value("fault_degraded", site="pipeline.dispatch",
                             to="oracle") >= 1
    br_b = breaker.lookup("pipeline.dispatch", ("pb", 256))
    assert br_b is None or br_b.state == breaker.CLOSED


def test_card_blocks_get_no_oracle(telemetry, monkeypatch):
    # a block already on the card retries, then re-raises: no oracle
    monkeypatch.setattr(faults, "on_card", lambda *a: True)
    cp = tpl.Pipeline([tpl.sosfilt(SOS)], name="cardline").compile(256)
    x = np.random.RandomState(15).randn(256).astype(np.float32)
    with faults.fault_plan("pipeline.dispatch:device_lost:9999"):
        with pytest.raises(faults.InjectedFault):
            cp.process(x)
    assert obs.counter_value("fault_retry",
                             site="pipeline.dispatch") == 2
    assert obs.counter_value("fault_degraded", site="pipeline.dispatch",
                             to="oracle") == 0


def test_card_state_gets_no_oracle(telemetry, monkeypatch):
    # after a stream's first block the carried state is on the card: a
    # host block with that state retries, then re-raises, no oracle
    x = np.random.RandomState(17).randn(256).astype(np.float32)
    card = set()
    monkeypatch.setattr(faults, "on_card",
                        lambda *ops: any(id(o) in card for o in ops))
    for name, entry in (("cardstate", "process"),
                        ("cardserve", "serve_step")):
        cp = tpl.Pipeline([tpl.sosfilt(SOS)], name=name).compile(256)
        _, state = cp.process(x)
        card.update(id(t) for t in tcomp._tree_leaves(state, []))
        obs.reset()
        with faults.fault_plan("pipeline.dispatch:device_lost:9999"):
            with pytest.raises(faults.InjectedFault):
                getattr(cp, entry)(x, state)
        assert obs.counter_value("fault_retry",
                                 site="pipeline.dispatch") == 2
        assert obs.counter_value("fault_degraded",
                                 site="pipeline.dispatch",
                                 to="oracle") == 0


def test_graph_step_serialises_threads():
    # one graph's static buffers are shared: each block's copy-in,
    # replay and copy-out must not interleave with another thread's
    import threading
    import time

    import torch

    class _Graph:
        def __init__(self, g):
            self.g = g

        def replay(self):
            x = self.g.x.clone()
            time.sleep(0.0005)      # widen the race window
            self.g.out.copy_(2 * x)
            self.g.new_states[0].copy_(self.g.states[0] + 1)

    g = tcomp._GraphStep.__new__(tcomp._GraphStep)
    g.lock, g.replays = threading.Lock(), 0
    g.x, g.out = torch.zeros(8), torch.zeros(8)
    g.states, g.new_states = (torch.zeros(2),), (torch.zeros(2),)
    g.graph = _Graph(g)
    bad = []

    def worker(i):
        for _ in range(20):
            out, (st,) = g.run(torch.full((8,), float(i)),
                               (torch.full((2,), float(i)),))
            if not (torch.all(out == 2 * i) and torch.all(st == i + 1)):
                bad.append(i)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad and g.replays == 80


def test_serve_step_labels_degraded_blocks():
    cp = tpl.Pipeline([tpl.sosfilt(SOS)], name="served").compile(256)
    x = np.random.RandomState(16).randn(2, 256).astype(np.float32)
    st = cp.init_state((2,))
    out, st2, deg = cp.serve_step(x, st)
    assert not deg
    with faults.fault_plan("pipeline.dispatch:device_lost:9999"):
        out_d, _, deg = cp.serve_step(x, st)
    assert deg
    assert _rel(out_d, _np(out)) <= TOL
    rows = cp.out_rows(out, 2)
    assert len(rows) == 2 and rows[0].shape == (256,)
    assert len(cp.state_rows(st2, 2)) == 2


def test_capture_error_names_the_stage():
    e = tcomp.PipelineCaptureError("p", "stft", RuntimeError("boom"))
    assert "stft" in str(e) and e.stage == "stft" and e.pipeline == "p"


def test_stage_constants_are_placed_at_compile():
    import torch

    _, cp = _both("monitor", 512)
    placed = {st.name: st for st in cp._stages}
    assert isinstance(placed["sosfilt"]._powers, list)
    assert all(isinstance(t, torch.Tensor)
               for t in placed["detrend"]._consts)
    assert isinstance(placed["savgol"]._taps, torch.Tensor)
    assert isinstance(placed["welch"]._dev[2], torch.Tensor)
    fir = tpl.Pipeline([tpl.fir(H63)]).compile(128)
    assert isinstance(fir._stages[0]._h_dev, torch.Tensor)
    st = tstages.stft(256, 64)
    cp2 = tpl.Pipeline([st]).compile(256)
    assert isinstance(cp2._stages[0]._op, torch.Tensor)
    assert st._op is None           # compile works on private copies
