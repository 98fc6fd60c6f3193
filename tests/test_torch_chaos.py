"""The port's chaos-campaign runner (``tools/chaos_torch.py``) on the CPU.

Each campaign — the four-phase single-server one, the replica one with
thread replicas, and the scale one — runs once, at ``--smoke``, in a
process of its own (``VELES_SIMD_PLATFORM=cpu``, no fault backoff) under
its own time limit, and the tests below read its details file: rc 0,
every invariant true, the invariant and row ``metric`` names equal to
the JAX tool's (``tools/chaos.py``, written out here), and the file
gated by ``tools/bench_regress.py`` (which imports no JAX) as
``tests/test_chaos.py`` gates the JAX tool's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import bench_regress  # noqa: E402

# seconds a smoke campaign may take here (each takes 5-25 s alone)
CAMPAIGN_TIMEOUT_S = 300

# the JAX tool's invariants (tools/chaos.py run_campaign,
# _replica_campaign_body, _scale_campaign_body)
INVARIANTS = {
    "single": {
        "answers_accounted", "breaker_closed_at_end", "breaker_cycle",
        "deadline_misses_bounded", "degraded_tickets_have_degrade_edge",
        "health_degraded_then_healthy", "mesh_breaker_closed_at_end",
        "mesh_breaker_cycle", "mesh_degrade_observed", "parity_clean",
        "pipeline_breaker_closed_at_end", "pipeline_breaker_cycle",
        "pipeline_degraded_then_served",
        "plain_ok_during_pipeline_poison", "scrape_live_mid_campaign",
        "sheds_typed", "slo_gauges_exported",
        "trace_phases_sum_to_total", "zero_double_answered",
        "zero_lost", "zero_orphaned_traces", "zero_retry_steady_state",
        "zero_untyped_errors"},
    "replicas": {
        "answers_accounted", "drain_graceful",
        "failover_deadlines_carried", "failover_observed",
        "fleet_goodput_sane", "fleet_kill_visible",
        "fleet_trace_deadline_carried", "fleet_trace_stitched",
        "fleet_tracing_overhead_ok", "group_healthz_200",
        "group_healthz_live", "heartbeats_observed",
        "incident_closed_live", "journal_breaker_cycle_recovered",
        "journal_incident_reconstructed", "journal_lifecycle_recovered",
        "journal_overhead_ok", "journal_pack_readable", "kill_recorded",
        "killed_replica_frozen", "killed_replica_traces_terminal",
        "parity_clean", "restart_answered", "restart_recorded",
        "restart_within_budget", "survivors_absorb_traffic",
        "trace_phases_sum_to_total", "zero_double_answered",
        "zero_lost", "zero_orphaned_traces", "zero_untyped_errors"},
    "scale": {
        "answers_accounted", "bounds_respected", "flap_storm_no_thrash",
        "incident_chain_scripted", "journal_every_tick_recovered",
        "journal_noops_typed", "journal_pack_readable",
        "journal_scale_story_recovered", "p99_within_budget",
        "parity_clean", "postmortem_chain_rendered",
        "postmortem_effect_moved", "replica_seconds_bounded",
        "scaled_down", "scaled_up", "scaler_route_live",
        "scaler_snapshot_live", "settled_to_min", "slo_hit_rate_held",
        "zero_double_answered", "zero_lost", "zero_untyped_errors"},
}

# the JAX tool's row metrics
ROWS = {
    "single": {
        "chaos requests answered", "chaos campaign throughput",
        "chaos deadline hit rate", "chaos mesh_loss throughput",
        "chaos pipeline_poison throughput", "chaos recovery throughput",
        "chaos breaker short circuits"},
    "replicas": {
        "replica campaign answered", "replica failover throughput",
        "replica drain throughput", "replica restart first request",
        "replica failovers", "fleet signal lag",
        "replica campaign goodput", "fleet tracing overhead",
        "journal overhead"},
    "scale": {
        "scale campaign answered", "scale p99 under ramp",
        "scale replica-seconds vs oracle", "scale slo hit rate",
        "scale decision lag"},
}

ARGV = {"single": [], "replicas": ["--replicas"], "scale": ["--scale"]}
TAIL = {"single": "chaos_invariants", "replicas": "replica_invariants",
        "scale": "scale_invariants"}
DETAILS = {"single": "CHAOS_DETAILS_torch.json",
           "replicas": "REPLICA_DETAILS_torch.json",
           "scale": "SCALE_DETAILS_torch.json"}


@pytest.fixture(scope="module", params=sorted(ARGV))
def campaign(request, tmp_path_factory):
    """One ``--smoke`` run of a campaign in its own process; its
    details file is written under the default ``_torch`` name in a
    fresh directory."""
    name = request.param
    work = tmp_path_factory.mktemp(f"chaos_{name}")
    env = dict(os.environ, VELES_SIMD_PLATFORM="cpu",
               VELES_SIMD_FAULT_BACKOFF="0", JAX_PLATFORMS="cpu")
    for var in ("VELES_SIMD_FAULT_PLAN", "VELES_SIMD_OBS_PORT",
                "VELES_SIMD_SCALER", "VELES_SIMD_JOURNAL_DIR"):
        env.pop(var, None)
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "chaos_torch.py"),
         "--smoke"] + ARGV[name], cwd=work, env=env,
        capture_output=True, text=True, timeout=CAMPAIGN_TIMEOUT_S)
    details = work / DETAILS[name]
    entries = (json.loads(details.read_text()) if details.exists()
               else None)
    return name, out, details, entries


def test_campaign_green(campaign):
    name, out, _, entries = campaign
    assert out.returncode == 0, (name, out.stderr[-3000:])
    assert "campaign green" in out.stderr
    assert entries is not None


def test_every_invariant_holds_under_the_jax_names(campaign):
    name, out, _, entries = campaign
    inv = entries[-1][TAIL[name]]
    assert set(inv) == INVARIANTS[name]
    assert len(inv) == {"single": 23, "replicas": 31, "scale": 22}[name]
    assert {k: v for k, v in inv.items() if not v} == {}
    # the stdout JSON carries the same verdicts
    printed = json.loads(out.stdout)
    assert printed["invariants"] == inv


def test_row_metrics_are_the_jax_names(campaign):
    name, _, _, entries = campaign
    rows = [e for e in entries if "metric" in e]
    assert {r["metric"] for r in rows} == ROWS[name]
    assert len(rows) == {"single": 7, "replicas": 9, "scale": 5}[name]
    for r in rows:
        assert set(r) >= {"metric", "value", "unit"}


def test_details_gate_via_bench_regress(campaign):
    _, _, details, entries = campaign
    rows = [e for e in entries if "metric" in e]
    loaded, _ = bench_regress.load_run(str(details))
    assert len(loaded) == len(rows)
    history = details.parent / "HISTORY.jsonl"
    assert bench_regress.main(["--details", str(details),
                               "--history", str(history)]) == 0


def test_evidence_tail_carries_the_story(campaign):
    name, _, _, entries = campaign
    tail = entries[-1]
    if name == "single":
        transitions = {e["decision"] for e in tail["breaker_transitions"]}
        assert {"open", "half_open", "closed"} <= transitions
        assert tail["mesh_degrade_events"]
        assert all(e["mesh"] for e in tail["mesh_degrade_events"])
        assert tail["fault_phases"][:5] == [
            "baseline", "overload", "pipeline_poison", "mesh_loss",
            "recovery"]
        assert tail["retry_attempts_steady_state"] == 0
        assert tail["plain_degraded_during_pipeline_poison"] == 0
        scrape = tail["scrape_mid_campaign"]
        assert set(scrape["routes"]) == {"/metrics", "/healthz",
                                         "/debug/requests"}
    elif name == "replicas":
        lifecycle = {(e["decision"], e.get("replica"))
                     for e in tail["replica_lifecycle_events"]}
        assert {("kill", "r0"), ("drain", "r1"), ("dead", "r1"),
                ("restart", "r0")} <= lifecycle
        assert tail["answered_final"].get("r0", 0) \
            == tail["answered_after_kill"].get("r0", 0)
        assert tail["spawn"] == "thread"
        # the overhead rows' A/A arm reads near 1 against itself
        for row in entries:
            if "overhead" in row.get("metric", ""):
                assert row["telemetry"]["aa_ratio"] is not None
    else:
        assert {"scale_up", "scale_down"} <= set(
            tail["journal"]["scaler_actions"])
        assert "scaler actions linked" in tail["journal"]["postmortem"]
        assert tail["ramp"]["alive_max"] >= 2


def test_details_names_are_the_port_names():
    # the port's files never overwrite the JAX tool's
    src = (REPO / "tools" / "chaos_torch.py").read_text()
    for name in DETAILS.values():
        assert name in src
    assert "REPLICA_RPC_DETAILS_torch.json" in src
    gitignore = (REPO / ".gitignore").read_text().split()
    for name in list(DETAILS.values()) + [
            "REPLICA_RPC_DETAILS_torch.json"]:
        assert name in gitignore
