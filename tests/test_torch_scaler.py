"""The port's autoscaler (``veles/simd_tpu_torch/serve/scaler.py``)
against the JAX package's.

The engine's clock is the signals bundle's own ``at_s`` stamp, so each
case drives both packages' ``ScalerEngine`` with the same scripted
signal sequence, on twin group shims shaped like ``tools/chaos.py``'s
(``_ShimGroup``: the verbs are recorded, no server is born), and holds
them to the same decision sequence: every decision record (action,
rule, typed no-op reason, replica, linked incident, streak, the full
input vector), the verbs called on the group, the counts in
``snapshot()`` and the ``scaler`` decision events.  Plus the knobs'
parsing, the disarmed ``/scaler`` shell, and the group's arm/disarm
lifecycle.  No sleeps but the lifecycle case's.
"""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from veles.simd_tpu import obs as jobs  # noqa: E402
from veles.simd_tpu.serve import scaler as jscaler  # noqa: E402
from veles.simd_tpu_torch import obs  # noqa: E402
from veles.simd_tpu_torch.serve import cluster  # noqa: E402
from veles.simd_tpu_torch.serve import scaler  # noqa: E402
from veles.simd_tpu_torch.utils import config  # noqa: E402

ENV_NAMES = [n for n in scaler.__all__ if n.endswith("_ENV")]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    prev = config.get_config()
    config.set_config(device="cpu")
    for name in ENV_NAMES:
        monkeypatch.delenv(getattr(scaler, name), raising=False)
    for o in (obs, jobs):
        o.enable(compile_listeners=False)
        o.reset()
    scaler._reset_for_tests()
    jscaler._reset_for_tests()
    yield
    scaler._reset_for_tests()
    jscaler._reset_for_tests()
    for o in (obs, jobs):
        o.disable()
        o.reset()
    config.set_config(**dataclasses.asdict(prev))


class _ShimReplica:
    def __init__(self, rid):
        self.rid = rid


class ShimGroup:
    """The group surface the engine acts through (``tools/chaos.py``'s
    ``_ShimGroup``), with scriptable verb failures."""

    def __init__(self, n=2, restart_exc=None, spawn_exc=None,
                 retire_exc=None):
        self.rids = [f"r{i}" for i in range(n)]
        self._next = n
        self.calls = []
        self.restart_exc = restart_exc
        self.spawn_exc = spawn_exc
        self.retire_exc = retire_exc

    def alive(self):
        return len(self.rids)

    def live_replicas(self):
        return [_ShimReplica(r) for r in self.rids]

    def spawn_replica(self):
        self.calls.append(("spawn",))
        if self.spawn_exc is not None:
            raise self.spawn_exc
        rid = f"r{self._next}"
        self._next += 1
        self.rids.append(rid)
        return _ShimReplica(rid)

    def retire(self, rid, reason="scale_down"):
        self.calls.append(("retire", rid, reason))
        if self.retire_exc is not None:
            raise self.retire_exc
        self.rids.remove(rid)

    def restart(self, rid):
        self.calls.append(("restart", rid))
        if self.restart_exc is not None:
            raise self.restart_exc
        return _ShimReplica(rid)


def _sig(t, *, burn=0.0, bvel=0.0, depth=0.0, per_replica=None,
         flaps=0, goodput=1.0, health=None, incidents=()):
    """A FleetSignals-shaped bundle on a scripted clock."""
    return SimpleNamespace(
        at_s=float(t),
        slo_burn={"carol": float(burn)} if burn else {},
        slo_burn_velocity={"carol": float(bvel)} if bvel else {},
        queue_depth=dict(per_replica or {}),
        queue_depth_total=float(depth),
        breaker_flaps={"serve": int(flaps)} if flaps else {},
        goodput_overall=float(goodput),
        health=dict(health or {}),
        incidents=list(incidents))


def _ramp():
    """A diurnal ramp: idle, a burn climb with a backlog, the peak,
    then a long idle tail (scale_up, then scale_down)."""
    sigs = [_sig(0.1 * i) for i in range(2)]
    sigs += [_sig(0.4 + 0.1 * i, burn=0.3 * i, bvel=1.0, depth=4.0 * i,
                  per_replica={"r0": 2.0 * i, "r1": 2.0 * i})
             for i in range(1, 8)]
    sigs += [_sig(1.2 + 0.1 * i, depth=0.0,
                  per_replica={"r0": 0.0, "r1": 1.0, "r2": 0.0})
             for i in range(40)]
    return sigs


def _down_replica():
    """A replica reads down, then stale, with an open incident the
    decision links; it recovers."""
    inc = [{"id": "inc-1", "rule": "replica_down"}]
    sigs = [_sig(0.1 * i, health={"r0": "healthy", "r1": "down"},
                 incidents=inc) for i in range(5)]
    sigs += [_sig(0.5 + 0.1 * i, health={"r0": "healthy",
                                         "r1": "stale"},
                  incidents=inc) for i in range(3)]
    sigs += [_sig(0.8 + 0.1 * i, health={"r0": "healthy",
                                         "r1": "healthy"})
             for i in range(5)]
    return sigs


def _flap_storm():
    """Breaker flaps with single-tick spikes: zero actions."""
    return [_sig(0.05 * i, flaps=6, burn=(1.5 if i % 2 else 0.0),
                 depth=(3.0 if i % 3 == 0 else 1.5))
            for i in range(40)]


def _random(seed):
    rng = np.random.RandomState(seed)
    sigs = []
    for i in range(120):
        kind = rng.randint(6)
        sigs.append(_sig(
            0.05 * i,
            burn=float(rng.choice([0.0, 0.2, 0.6, 1.4])),
            bvel=float(rng.choice([0.0, 0.3, 0.9])),
            depth=float(rng.choice([0.0, 0.5, 3.0, 25.0])),
            per_replica={f"r{j}": float(rng.randint(4))
                         for j in range(4)},
            flaps=int(rng.randint(3)),
            goodput=float(rng.uniform(0.3, 1.0)),
            health=({"r1": "down"} if kind == 0 else
                    {"r0": "stale"} if kind == 1 else {}),
            incidents=([{"id": "inc-7", "rule": "slo_burn"}]
                       if kind == 2 else [])))
    return sigs


SCENARIOS = {
    "ramp": (_ramp, {}, {}),
    "down_replica": (_down_replica, {}, {}),
    "flap_storm": (_flap_storm, {}, {}),
    "random_0": (lambda: _random(0), {}, {}),
    "random_1": (lambda: _random(1), {"cooldown_s": 0.2}, {}),
    "random_2": (lambda: _random(2), {"max_replicas": 3,
                                      "down_ticks": 2}, {}),
    "restart_pending": (_down_replica, {},
                        {"restart_exc": ValueError("not dead yet")}),
    "spawn_failed": (_ramp, {}, {"spawn_exc": RuntimeError("boom")}),
    "retire_failed": (_ramp, {}, {"retire_exc": RuntimeError("boom")}),
}


def _engine(mod, group, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("cooldown_s", 1.0)
    kw.setdefault("up_ticks", 2)
    kw.setdefault("down_ticks", 3)
    return mod.ScalerEngine(group, **kw)


def _run(mod, o, scenario):
    make, kw, fails = SCENARIOS[scenario]
    group = ShimGroup(2, **fails)
    eng = _engine(mod, group, **kw)
    records = [eng.tick(s) for s in make()]
    events = [(e["decision"], e.get("rule"), e.get("reason"),
               e.get("replica"), e.get("incident_id"))
              for e in o.events() if e["op"] == "scaler"]
    snap = eng.snapshot()
    return records, group.calls, events, snap


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_same_signals_same_decisions(scenario):
    got = _run(scaler, obs, scenario)
    want = _run(jscaler, jobs, scenario)
    assert got[0] == want[0]                # decision records
    assert got[1] == want[1]                # verbs on the group
    assert got[2] == want[2]                # scaler decision events
    for key in ("ticks", "replicas", "config", "cooldown_remaining_s",
                "streaks", "actions", "noops", "last_action", "retired",
                "decisions", "schema", "armed", "running"):
        assert got[3][key] == want[3][key], key


def test_the_ramp_scales_up_then_down():
    records, calls, _, snap = _run(scaler, obs, "ramp")
    actions = [r["action"] for r in records if r["action"]]
    assert actions[0] == "scale_up" and "scale_down" in actions
    assert calls[0] == ("spawn",) and calls[-1][0] == "retire"
    assert snap["actions"]["scale_up"] >= 1
    assert obs.counter_value("scaler_action", action="scale_up",
                             rule=records[[r["action"] for r in records]
                                          .index("scale_up")]["rule"])


def test_flap_storm_takes_no_action():
    records, calls, _, _ = _run(scaler, obs, "flap_storm")
    assert calls == [] and not any(r["action"] for r in records)


def test_module_constants_and_knob_parsing(monkeypatch):
    names = [n for n in jscaler.__all__
             if n.isupper() and not callable(getattr(jscaler, n))]
    for name in names:
        assert getattr(scaler, name) == getattr(jscaler, name), name
    for raw in ("", "garbage", "-3", "0", "2.5", "7"):
        for env in ("MIN_ENV", "UP_TICKS_ENV", "COOLDOWN_MS_ENV",
                    "BURN_ENV"):
            monkeypatch.setenv(getattr(scaler, env), raw)
        a = _engine_defaults(scaler)
        b = _engine_defaults(jscaler)
        assert a == b, raw
    for raw in ("1", "true", "YES", "on", "0", "off", ""):
        monkeypatch.setenv(scaler.ARM_ENV, raw)
        assert scaler.armed_by_env() == jscaler.armed_by_env(), raw


def _engine_defaults(mod):
    eng = mod.ScalerEngine(ShimGroup(1))
    return {k: getattr(eng, k) for k in (
        "min_replicas", "max_replicas", "cooldown_s", "up_ticks",
        "down_ticks", "burn", "burn_velocity", "queue_velocity",
        "depth_high", "idle_depth")}


def test_disarmed_shell_and_registry():
    assert scaler.snapshot() == jscaler.snapshot()
    assert scaler.summary() == jscaler.summary()
    assert obs.scaler_snapshot() == scaler.snapshot()
    eng = _engine(scaler, ShimGroup(2))
    scaler._register(eng)
    try:
        assert scaler.engine() is eng and scaler.armed()
        assert obs.scaler_snapshot()["armed"] is True
        assert obs.signals().scaler["armed"] is True
    finally:
        scaler._unregister(eng)
    assert not scaler.armed()


def test_group_arms_and_disarms_the_scaler():
    with cluster.ReplicaGroup(1, max_batch=2, max_wait_ms=1.0, workers=1,
                              obs_port=-1, scaler=True,
                              scaler_tick_ms=10.0,
                              scaler_kwargs={"min_replicas": 1,
                                             "max_replicas": 1}) as g:
        assert scaler.armed()
        assert g.stats()["scaler"]["armed"] is True
    assert not scaler.armed()
    with cluster.ReplicaGroup(1, max_batch=2, max_wait_ms=1.0, workers=1,
                              obs_port=-1):
        assert not scaler.armed()


def test_lint_control_rule_passes_on_the_port_scaler():
    import ast

    sys.path.insert(0, str(REPO / "tools"))
    import lint

    path = REPO / "veles" / "simd_tpu_torch" / "serve" / "scaler.py"
    text = path.read_text().replace("veles.simd_tpu_torch",
                                    "veles.simd_tpu")
    assert lint.scaler_control_errors(ast.parse(text), "scaler.py") == []
    # not vacuous on the rewritten text: a submission, a .server
    # reach-in or an obs side-door read is caught
    for bad in ("self.group.replicas[0].server.submit(None)",
                "obs.snapshot()", "self.group.register_pipeline(1, 2)"):
        text2 = text.replace("        plan[\"action\"] = winner\n",
                             f"        {bad}\n"
                             "        plan[\"action\"] = winner\n")
        assert text2 != text
        assert lint.scaler_control_errors(ast.parse(text2), "scaler.py")
